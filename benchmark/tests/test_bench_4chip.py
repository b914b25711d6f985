"""The pieces of ``orders_customer_4chip``: the link's byte count, the new
metrics' readers on a synthetic traced slice, the chunk generator, and the
driver's CPU path (``rows=``) with gloo ranks against the reference."""
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.control import run_control
from benchmark.data.orders_customer_chunks import (chunk_range,
                                                   orders_customer_chunk)
from benchmark.harness import main as harness
from benchmark.harness import spans
from benchmark.harness.link_bytes import (NVLINK_BYTES_PER_S,
                                          least_off_card_bytes)
from benchmark.harness.loop import Request
from benchmark.harness.trace import Op, TracedRequest, TraceSlice
from benchmark.metrics import (all_to_all_link_pct, collective_ms,
                               exchange_slots_per_row)

CELL = "orders_customer_4chip"
MANIFEST = harness.load_manifest()


def test_least_off_card_bytes():
    # 1,000 survivors over 4 cards: 250 a card, 3/4 of them leave, 16 B
    assert least_off_card_bytes(1000, 4) == 250 * 3 / 4 * 16
    assert least_off_card_bytes(1000, 1) == 0
    assert NVLINK_BYTES_PER_S == 450e9


def _span(name, start, end, parent=-1, device_ms=None, **counters):
    return SimpleNamespace(name=name, start=start, end=end, parent=parent,
                           request=0, counters=counters,
                           device_ms=device_ms)


def _slice(device, survivors=(4000, 2000), facts=True):
    """Two requests, [0, 100) and [100, 200) ns, with their survivors;
    ``device``: (name, start, end) of the device operations."""
    reqs = [TracedRequest(Request("q", 10_000, None, survivors=n,
                                  facts={"partitions": 4} if facts
                                  else None),
                          Op("bench.request", s, s + 100),
                          Op("bench.call", s, s + 90))
            for s, n in zip((0, 100), survivors)]
    ops = [Op(n, s, e) for n, s, e in device]
    for o in ops:
        reqs[o.start >= 100].device.append(o)
    return TraceSlice(reqs, ops, [], 0, 200)


def _run(trace, found):
    spans._LAST[:] = [trace, spans.assign(trace, found)]
    return SimpleNamespace(trace=trace)


def test_collective_ms_takes_self_time_a_request():
    found = [_span("gt.exchange", 1, 50, device_ms=9.0, slots=30, rows=30),
             _span("gt.collective.all_to_all", 2, 40, parent=0,
                   device_ms=4.0, bytes_off_card=96, bytes_on_card=32),
             _span("gt.collective.all_gather", 60, 70, device_ms=1.0),
             _span("gt.collective.all_reduce", 120, 130, device_ms=0.5),
             _span("gt.exchange", 140, 190, device_ms=2.0, slots=10,
                   rows=10)]
    run = _run(_slice([]), found)
    assert collective_ms.read(run) == (4.0 + 1.0 + 0.5) / 2
    assert exchange_slots_per_row.read(run) == 1.0


def test_exchange_slots_per_row_reads_the_counters():
    found = [_span("gt.exchange", 1, 50, slots=300, rows=100),
             _span("gt.exchange", 110, 150, slots=100, rows=100),
             _span("gt.exchange", 160, 190)]          # a program that
    run = _run(_slice([]), found)                     # counts nothing
    assert exchange_slots_per_row.read(run) == 2.0
    run = _run(_slice([]), [_span("gt.exchange", 1, 50)])
    assert exchange_slots_per_row.read(run) is None
    run = _run(_slice([]), [])
    assert all(m.read(run) is None for m in (collective_ms,
                                             exchange_slots_per_row))


def test_link_share_is_least_bytes_over_sendrecv_time():
    dev = [("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
            10, 30),
           ("ncclDevKernel_AllGather_RING_LL(x)", 30, 40),
           ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
            110, 120),
           ("void at::native::vectorized_gather_kernel", 120, 150)]
    run = SimpleNamespace(trace=_slice(dev))
    need = least_off_card_bytes(4000, 4) + least_off_card_bytes(2000, 4)
    want = 100.0 * need / NVLINK_BYTES_PER_S / (30 / 1e9)
    assert all_to_all_link_pct.read(run) == pytest.approx(want)
    # no send/recv kernel, or requests that carry no partitions: nothing
    assert all_to_all_link_pct.read(SimpleNamespace(
        trace=_slice(dev[1:2]))) is None
    assert all_to_all_link_pct.read(SimpleNamespace(
        trace=_slice(dev, facts=False))) is None


def test_chunks_are_disjoint_whole_and_seeded():
    orders, lines, customers, n = 4000, 16_001, 402, 4
    made = [orders_customer_chunk(300, orders, lines, customers, n, k,
                                  2**31 + 7, "cpu") for k in range(n)]
    ranges = [c["orders_range"] for c in made]
    assert ranges[0][0] == 0 and ranges[-1][1] == orders
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert sum(c["o_custkey"].numel() for c in made) == orders
    keys = torch.cat([c["c_custkey"] for c in made])
    assert torch.equal(keys, torch.arange(1, customers + 1))
    assert [chunk_range(lines, n, k) for k in range(n)][-1][1] == lines
    assert all(int(c["o_custkey"].max()) <= customers for c in made)
    again = orders_customer_chunk(300, orders, lines, customers, n, 2,
                                  2**31 + 7, "cpu")
    other = orders_customer_chunk(300, orders, lines, customers, n, 2,
                                  2**31 + 8, "cpu")
    for k in ("o_custkey", "o_totalprice", "c_custkey", "c_mktsegment"):
        assert torch.equal(again[k], made[2][k]), k
    assert not torch.equal(other["o_totalprice"], made[2]["o_totalprice"])
    assert not torch.equal(made[1]["o_totalprice"], made[2]["o_totalprice"])


def test_driver_on_gloo_ranks_matches_the_reference():
    result, checks, info = harness.run_cell(
        CELL, 2**31 + 77, 1.0, False, time.perf_counter(), device="cpu",
        rows=8000, manifest=MANIFEST)
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] > 0
    # every rank compares its own copy of every answer
    assert info["compared_answers"] == 4 * result["attempted"]
    assert len(info["pipeline_counts"]["memory_peak_bytes_by_rank"]) == 4


def test_control_on_gloo_ranks_is_not_correct():
    c = run_control(CELL, 2**31 + 3, device="cpu", rows=20_000,
                    manifest=MANIFEST)
    assert c["compared_answers"] > 0 and not c["correct"], c
